"""Built-in chat web UI (parity: tools/server/webui + the SparkInfer
launcher's chat page, tools/launcher/server.js).

A full single-file app (no build step, no external assets — the server
is usable from a browser with zero egress): multi-conversation chat with
localStorage persistence, SSE streaming with stop/regenerate, minimal
markdown rendering (code blocks / inline code / bold / headings /
lists), per-message timing + tokens/s, a live server panel polling
/props, /slots and /metrics, and a settings drawer (system prompt,
temperature, top_p, top_k, max_tokens, JSON mode).
"""

INDEX_HTML = r"""<!doctype html>
<html><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width,initial-scale=1">
<title>sparkinfer-tpu</title>
<style>
:root{--bg:#0f1115;--bg2:#171a21;--bg3:#1f2430;--fg:#e6e9ef;--dim:#8a93a6;
 --acc:#53d1b6;--acc2:#6ea8fe;--err:#ff7a90;--border:#2a3040}
*{box-sizing:border-box}
body{margin:0;font:15px/1.45 system-ui,-apple-system,sans-serif;
 background:var(--bg);color:var(--fg);display:flex;height:100vh}
#side{width:260px;min-width:200px;background:var(--bg2);display:flex;
 flex-direction:column;border-right:1px solid var(--border)}
#brand{padding:.9rem 1rem;font-weight:600;color:var(--acc);
 border-bottom:1px solid var(--border)}
#brand small{color:var(--dim);font-weight:400;display:block}
#convs{flex:1;overflow-y:auto;padding:.4rem}
.conv{padding:.45rem .6rem;border-radius:6px;cursor:pointer;
 white-space:nowrap;overflow:hidden;text-overflow:ellipsis;color:var(--dim)}
.conv:hover{background:var(--bg3)}
.conv.active{background:var(--bg3);color:var(--fg)}
.conv .del{float:right;visibility:hidden;color:var(--err)}
.conv:hover .del{visibility:visible}
#newc{margin:.5rem;padding:.5rem;text-align:center;border:1px dashed
 var(--border);border-radius:6px;cursor:pointer;color:var(--acc)}
#srv{border-top:1px solid var(--border);padding:.6rem .8rem;
 font-size:.78rem;color:var(--dim)}
#srv b{color:var(--fg);font-weight:600}
#srv .ok{color:var(--acc)} #srv .bad{color:var(--err)}
#main{flex:1;display:flex;flex-direction:column;min-width:0}
#top{display:flex;align-items:center;gap:.6rem;padding:.55rem .9rem;
 border-bottom:1px solid var(--border);background:var(--bg2)}
#model{color:var(--acc2);font-size:.85rem;overflow:hidden;
 text-overflow:ellipsis;white-space:nowrap;flex:1}
#top button{background:var(--bg3);color:var(--fg);border:1px solid
 var(--border);border-radius:6px;padding:.3rem .7rem;cursor:pointer}
#chat{flex:1;overflow-y:auto;padding:1rem 1.2rem;scroll-behavior:smooth}
.msg{max-width:56rem;margin:0 auto .9rem}
.msg .who{font-size:.72rem;text-transform:uppercase;letter-spacing:.08em;
 color:var(--dim);margin-bottom:.15rem}
.msg.user .who{color:var(--acc2)} .msg.assistant .who{color:var(--acc)}
.msg .body{white-space:pre-wrap;word-wrap:break-word}
.msg .body code{background:var(--bg3);padding:.1em .35em;border-radius:4px;
 font-size:.9em}
.msg .body pre{background:var(--bg3);border:1px solid var(--border);
 border-radius:8px;padding:.7rem;overflow-x:auto;white-space:pre}
.msg .body pre code{background:none;padding:0}
.msg .body h1,.msg .body h2,.msg .body h3{margin:.4em 0 .2em;
 font-size:1.05em;color:var(--acc2)}
.msg .body li{margin-left:1.2em}
.msg .think{color:var(--dim);font-style:italic;border-left:2px solid
 var(--border);padding-left:.6rem;margin:.3rem 0}
.msg .tool{color:var(--acc2);font-family:monospace;font-size:.85em}
.msg .stats{font-size:.72rem;color:var(--dim);margin-top:.2rem}
#inbar{padding:.8rem 1rem 1rem;border-top:1px solid var(--border);
 background:var(--bg2)}
#inwrap{max-width:56rem;margin:0 auto;display:flex;gap:.5rem}
#inp{flex:1;resize:none;background:var(--bg3);color:var(--fg);
 border:1px solid var(--border);border-radius:8px;padding:.6rem .8rem;
 font:inherit;max-height:10rem}
#send{background:var(--acc);color:#06281f;font-weight:600;border:0;
 border-radius:8px;padding:0 1.1rem;cursor:pointer}
#send.stop{background:var(--err);color:#2b0a12}
#drawer{position:fixed;top:0;right:-340px;width:330px;height:100vh;
 background:var(--bg2);border-left:1px solid var(--border);
 transition:right .2s;padding:1rem;overflow-y:auto;z-index:10}
#drawer.open{right:0}
#drawer h3{margin:.2rem 0 .8rem;color:var(--acc)}
#drawer label{display:block;font-size:.78rem;color:var(--dim);
 margin:.6rem 0 .15rem}
#drawer input,#drawer textarea,#drawer select{width:100%;background:var(--bg3);
 color:var(--fg);border:1px solid var(--border);border-radius:6px;
 padding:.4rem .5rem;font:inherit}
#drawer textarea{min-height:5rem;resize:vertical}
</style></head><body>
<div id="side">
 <div id="brand">sparkinfer-tpu<small id="health">connecting…</small></div>
 <div id="newc">+ new chat</div>
 <div id="convs"></div>
 <div id="srv">server…</div>
</div>
<div id="main">
 <div id="top">
  <span id="model"></span>
  <button onclick="regen()" title="regenerate last">&#8635; regen</button>
  <button onclick="drawer.classList.toggle('open')">&#9881; settings</button>
 </div>
 <div id="chat"></div>
 <div id="inbar"><div id="inwrap">
  <textarea id="inp" rows="2"
    placeholder="message…  (Enter to send, Shift+Enter for newline)"></textarea>
  <button id="send" onclick="sendOrStop()">send</button>
 </div></div>
</div>
<div id="drawer">
 <h3>settings</h3>
 <label>system prompt</label><textarea id="s_sys"></textarea>
 <label>temperature</label><input id="s_temp" type="number" step="0.05" value="0.8">
 <label>top_p</label><input id="s_topp" type="number" step="0.05" value="0.95">
 <label>top_k</label><input id="s_topk" type="number" step="1" value="40">
 <label>max_tokens</label><input id="s_max" type="number" step="16" value="512">
 <label>response format</label>
 <select id="s_fmt"><option value="">text</option>
  <option value="json_object">json</option></select>
</div>
<script>
"use strict";
const $=id=>document.getElementById(id);
const drawer=$('drawer');
let convs=JSON.parse(localStorage.getItem('spif_convs')||'[]');
let cur=convs.length?0:null, ctrl=null;
if(cur===null){convs=[{title:'new chat',msgs:[]}];cur=0;}
function save(){localStorage.setItem('spif_convs',JSON.stringify(convs));}
function md(t){
  // minimal markdown: fenced code, inline code, headings, bold, lists
  const esc=s=>s.replace(/&/g,'&amp;').replace(/</g,'&lt;');
  let out='',parts=t.split(/```/);
  for(let i=0;i<parts.length;i++){
    if(i%2){ // code block; first line may be a language tag
      const nl=parts[i].indexOf('\n');
      const code=nl>=0?parts[i].slice(nl+1):parts[i];
      out+='<pre><code>'+esc(code)+'</code></pre>';
    }else{
      out+=esc(parts[i])
        .replace(/`([^`\n]+)`/g,'<code>$1</code>')
        .replace(/^### (.*)$/gm,'<h3>$1</h3>')
        .replace(/^## (.*)$/gm,'<h2>$1</h2>')
        .replace(/^# (.*)$/gm,'<h1>$1</h1>')
        .replace(/\*\*([^*]+)\*\*/g,'<b>$1</b>')
        .replace(/^[-*] (.*)$/gm,'<li>$1</li>');
    }
  }
  return out;
}
function renderConvs(){
  $('convs').innerHTML='';
  convs.forEach((c,i)=>{
    const d=document.createElement('div');
    d.className='conv'+(i===cur?' active':'');
    d.textContent=c.title;
    const x=document.createElement('span');x.className='del';
    x.textContent='×';
    x.onclick=e=>{e.stopPropagation();convs.splice(i,1);
      if(!convs.length)convs=[{title:'new chat',msgs:[]}];
      cur=Math.min(cur,convs.length-1);save();renderConvs();renderChat();};
    d.appendChild(x);
    d.onclick=()=>{cur=i;renderConvs();renderChat();};
    $('convs').appendChild(d);
  });
}
function msgEl(m){
  const d=document.createElement('div');d.className='msg '+m.role;
  const who=document.createElement('div');who.className='who';
  who.textContent=m.role;d.appendChild(who);
  const b=document.createElement('div');b.className='body';
  if(m.think){const th=document.createElement('div');th.className='think';
    th.textContent=m.think;d.appendChild(th);}
  b.innerHTML=md(m.content||'');d.appendChild(b);
  if(m.tool){const tl=document.createElement('div');tl.className='tool';
    tl.textContent=m.tool;d.appendChild(tl);}
  if(m.stats){const st=document.createElement('div');st.className='stats';
    st.textContent=m.stats;d.appendChild(st);}
  return d;
}
function renderChat(){
  const c=$('chat');c.innerHTML='';
  convs[cur].msgs.forEach(m=>c.appendChild(msgEl(m)));
  c.scrollTop=c.scrollHeight;
}
async function sendOrStop(){
  if(ctrl){ctrl.abort();return;}
  const text=$('inp').value.trim();if(!text)return;
  $('inp').value='';
  const c=convs[cur];
  if(c.msgs.length===0)c.title=text.slice(0,34);
  c.msgs.push({role:'user',content:text});
  save();renderConvs();renderChat();
  await complete();
}
async function regen(){
  const c=convs[cur];
  while(c.msgs.length&&c.msgs[c.msgs.length-1].role==='assistant')
    c.msgs.pop();
  if(!c.msgs.length)return;
  save();renderChat();await complete();
}
async function complete(){
  const c=convs[cur];
  const msgs=[];
  const sys=$('s_sys').value.trim();
  if(sys)msgs.push({role:'system',content:sys});
  c.msgs.forEach(m=>msgs.push({role:m.role,content:m.content}));
  const body={messages:msgs,stream:true,
    temperature:+$('s_temp').value,top_p:+$('s_topp').value,
    top_k:+$('s_topk').value,max_tokens:+$('s_max').value};
  if($('s_fmt').value)body.response_format={type:$('s_fmt').value};
  const am={role:'assistant',content:'',think:'',tool:''};
  c.msgs.push(am);renderChat();
  $('send').textContent='stop';$('send').classList.add('stop');
  ctrl=new AbortController();
  const t0=performance.now();let ntok=0;
  try{
    const res=await fetch('/v1/chat/completions',{method:'POST',
      headers:{'Content-Type':'application/json'},
      body:JSON.stringify(body),signal:ctrl.signal});
    if(!res.ok){am.content='[error '+res.status+'] '+await res.text();}
    else{
      const reader=res.body.getReader(),dec=new TextDecoder();
      let buf='';
      for(;;){
        const{value,done}=await reader.read();if(done)break;
        buf+=dec.decode(value,{stream:true});
        const lines=buf.split('\n');buf=lines.pop();
        for(const line of lines){
          if(!line.startsWith('data: '))continue;
          const p=line.slice(6);if(p==='[DONE]')continue;
          try{
            const d=JSON.parse(p),ch=d.choices[0],dl=ch.delta||{};
            if(dl.content){am.content+=dl.content;ntok++;}
            else if(ch.text){am.content+=ch.text;ntok++;}
            if(dl.reasoning_content)am.think+=dl.reasoning_content;
            for(const tc of dl.tool_calls||[]){
              const fn=tc.function||{};
              if(fn.name)am.tool+=fn.name+'(';
              if(fn.arguments)am.tool+=fn.arguments;
            }
            if(ch.finish_reason==='tool_calls')am.tool+=')';
          }catch(e){}
        }
        renderChat();
      }
    }
  }catch(e){if(e.name!=='AbortError')am.content+='\n['+e+']';}
  const dt=(performance.now()-t0)/1000;
  am.stats=`${ntok} chunks · ${dt.toFixed(1)}s · `+
    `${(ntok/Math.max(dt,.01)).toFixed(1)} tok/s`;
  ctrl=null;$('send').textContent='send';$('send').classList.remove('stop');
  save();renderChat();
}
$('newc').onclick=()=>{convs.unshift({title:'new chat',msgs:[]});cur=0;
  save();renderConvs();renderChat();};
$('inp').addEventListener('keydown',e=>{
  if(e.key==='Enter'&&!e.shiftKey){e.preventDefault();sendOrStop();}});
async function poll(){
  try{
    const pr=await (await fetch('/props')).json();
    $('model').textContent=(pr.model_name||pr.model_path||pr.model||'')+
      (pr.arch?` · ${pr.arch}`:'')+(pr.n_ctx?` · ctx ${pr.n_ctx}`:'');
    $('health').textContent='ready';$('health').className='ok';
    let slots=[];try{slots=await (await fetch('/slots')).json();}catch(e){}
    const busy=slots.filter(s=>s.running||s.is_processing).length;
    let mtx='';
    try{
      const t=await (await fetch('/metrics')).text();
      const g=re=>{const m=t.match(re);return m?(+m[1]).toFixed(1):'–';};
      mtx=`<b>${g(/n_tokens_generated (\S+)/)}</b> tok out · `+
          `<b>${g(/n_prompt_tokens (\S+)/)}</b> tok in · `+
          `<b>${g(/decode_tps (\S+)/)}</b> tok/s`;
    }catch(e){}
    $('srv').innerHTML=
      `<span class="ok">●</span> slots <b>${busy}/${slots.length||'–'}</b>`+
      ` busy<br>${mtx}`;
  }catch(e){
    $('health').textContent='offline';$('health').className='bad';
    $('srv').innerHTML='<span class="bad">●</span> unreachable';
  }
  setTimeout(poll,4000);
}
renderConvs();renderChat();poll();
</script></body></html>
"""
